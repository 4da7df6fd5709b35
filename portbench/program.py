"""The system under test, driven as its users drive it.

Two jobs, both closed loops of one client:

* ``frame``: ``Renderer(kernel=...).render_hdr()`` and the HDR image on the
  host (``utils.host.fetch``), the reference's defaults;
* ``fit``: one Adam step of an inverse-rendering fit, its loss on the host.
  Variant B goes through ``grad.inverse.fast_pixel_loss`` with the draws
  and the occluder cull made at set-up, as ``inverse_render(fast=True)``
  makes them; variant A through ``ops.render_mis_decoupled`` with the cull
  made at set-up. The parameters are scene tensors named in the traffic
  (``triangles.diffuse`` clamped to [0, 1], as ``apply_params`` clamps the
  spheres'; the light's emission).
* ``sharded_fit``: the variant-B fit step of
  ``parallel.train.make_train_step_fused`` on every rank of a process group,
  one rank a card (``portbench.ranks`` starts them).

Everything the program is given comes from the benchmark's scene arrays and
the run's seed. ``fault`` breaks the timed path on purpose, for the test
that shows the check fails then; a run never sets it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from gpuraytracer_tpu_torch import Renderer, RenderConfig, convert, ops
from gpuraytracer_tpu_torch.grad import inverse
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops.cuda_shade import _auto_records_only
from gpuraytracer_tpu_torch.parallel.fast import render_path_fused_sharded
from gpuraytracer_tpu_torch.parallel.mesh import make_ray_mesh
from gpuraytracer_tpu_torch.utils.host import fetch

FAULTS = ("frozen_step", "half_batch", "altered_answer")
# Pixels of each frame kept for the check.
FRAME_SAMPLE = 32


def render_config(traffic: Dict, seed: int) -> RenderConfig:
    return RenderConfig(
        width=traffic["width"], height=traffic["height"],
        integrator=traffic["integrator"], spp=traffic.get("spp", 1),
        bounces=traffic.get("bounces", 1),
        camera_rays=traffic.get("camera_rays", 1),
        mis_samples=traffic.get("mis_samples", 3),
        seed=seed & 0x7FFFFFFF)


def traffic_for_reference(traffic: Dict, seed: int) -> Dict:
    """The traffic with the render seed the program was given."""
    return dict(traffic, seed=seed & 0x7FFFFFFF)


def _with(obj, path: List[str], value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    return dataclasses.replace(obj, **{path[0]: _with(
        getattr(obj, path[0]), path[1:], value)})


def initial_values(tree: Dict, traffic: Dict, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """The fit's starting parameters, drawn on the device from the seed:
    the scene's values scaled by U(0.7, 1) (diffuse) or U(0.8, 1.2)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in traffic["params"]:
        part, key = name.split(".")
        base = torch.as_tensor(tree[part][key]).to(device)
        lo, span = (0.7, 0.3) if key == "diffuse" else (0.8, 0.4)
        scale = lo + span * torch.rand(base.shape, generator=gen,
                                       device=device)
        out[name] = base * scale
    return out


def target_image(traffic: Dict, seed: int, device) -> torch.Tensor:
    """The fit's target: U(0.5, 1.5) x the traffic's scale per value, from
    the seed (one draw after the parameters')."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    shape = (traffic["height"], traffic["width"], 3)
    return traffic["target_scale"] * (
        0.5 + torch.rand(shape, generator=gen, device=device))


class FrameJob:
    """Frames of ``Renderer(kernel=traffic['kernel'])`` read back to the
    host; keeps ``FRAME_SAMPLE`` seeded pixels of each for the check."""

    def __init__(self, tree, traffic, seed, device, spans,
                 fault: Optional[str] = None):
        self.spans, self.fault = spans, fault
        cfg = render_config(traffic, seed)
        if fault == "half_batch":
            cfg = cfg.replace(spp=max(1, cfg.spp // 2))
        self.renderer = Renderer(convert.scene_from_numpy(tree), cfg,
                                 kernel=traffic["kernel"], device=device)
        self.rng = np.random.Generator(np.random.PCG64(seed))
        self.n_pixels = cfg.num_pixels
        self.kept: List[np.ndarray] = []
        self.kept_ids: List[np.ndarray] = []

    def iterate(self) -> None:
        with self.spans.span("forward"):
            hdr = self.renderer.render_hdr()
        if self.fault == "altered_answer":
            hdr = hdr * 1.01
        with self.spans.span("readback"):
            host = fetch(hdr).reshape(-1, 3)
        ids = self.rng.integers(0, self.n_pixels, FRAME_SAMPLE)
        self.kept_ids.append(ids)
        self.kept.append(host[ids])

    def release(self) -> None:
        del self.renderer


class FitJob:
    """Adam steps of the fit. ``readings`` keeps, from the first three
    steps (made in set-up), what the check compares."""

    def __init__(self, tree, traffic, seed, device, spans,
                 fault: Optional[str] = None):
        self.spans, self.fault, self.traffic = spans, fault, traffic
        self.cfg = render_config(traffic, seed)
        self.scene = convert.scene_from_numpy(tree).to(device)
        self.device = device
        self.values = {k: v.clone().requires_grad_(True) for k, v in
                       initial_values(tree, traffic, seed, device).items()}
        self.target = target_image(traffic, seed, device)
        opt = traffic["optimizer"]
        self.opt = torch.optim.Adam(list(self.values.values()), lr=opt["lr"],
                                    betas=tuple(opt["betas"]),
                                    eps=opt["eps"])
        self.lr = opt["lr"]
        if traffic["integrator"] == "path":
            # As inverse_render(fast=True) hoists them.
            self.occluders = potential_occluders(self.scene, self.cfg,
                                                 sphere_slack=0.5)
            self.draws = (None if _auto_records_only(self.cfg)
                          else ops.pregen_draws(self.cfg, device=device))
        else:
            self.occluders = potential_occluders(self.scene, self.cfg)
        self.losses: List[float] = []

    def _scene(self):
        scene = self.scene
        for name, v in self.values.items():
            if name == "triangles.diffuse":
                v = torch.clamp(v, 0.0, 1.0)
            scene = _with(scene, name.split("."), v)
        return scene

    def _forward(self) -> torch.Tensor:
        scene = self._scene()
        target = self.target
        if self.traffic["integrator"] == "path":
            sp = scene.spheres
            params = inverse.SceneParams(sphere_centers=sp.center,
                                         sphere_diffuse=sp.diffuse,
                                         light_emission=scene.light.color)
            if self.fault is None:
                return inverse.fast_pixel_loss(
                    params, scene, self.cfg, target, draws=self.draws,
                    occluders=self.occluders, device=self.device)
            img = ops.render_path_decoupled(
                inverse.apply_params(scene, params), self.cfg,
                draws=self.draws, occluders=self.occluders,
                device=self.device)
        else:
            img = ops.render_mis_decoupled(scene, self.cfg,
                                           occluders=self.occluders,
                                           device=self.device)
        return self._loss(img, target)

    def _loss(self, img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The mean squared pixel loss, with ``fault`` planted."""
        if self.fault == "altered_answer":
            img = img * 1.01
        if self.fault == "half_batch":
            half = img.shape[0] // 2
            img, target = img[:half], target[:half]
        return torch.mean((img - target) ** 2)

    def iterate(self) -> float:
        self.opt.zero_grad(set_to_none=True)
        with self.spans.span("forward"):
            loss = self._forward()
        with self.spans.span("backward"):
            loss.backward()
        with self.spans.span("optimizer"):
            if self.fault != "frozen_step":
                self.opt.step()
        with self.spans.span("readback"):
            value = loss.item()
        self.losses.append(value)
        return value

    def first_steps(self, n: int = 3) -> Dict:
        """The first ``n`` steps, in set-up, through the loop's own call:
        their losses, the first gradient as Adam holds it after step 1
        (exp_avg / (1 - beta1)) and the values before and after."""
        start = {k: v.detach().clone() for k, v in self.values.items()}
        beta1 = self.opt.defaults["betas"][0]
        first = None
        for _ in range(n):
            self.iterate()
            if first is None:
                first = {}
                for k, v in self.values.items():
                    state = self.opt.state.get(v, {})
                    first[k] = (state["exp_avg"] / (1.0 - beta1)
                                if "exp_avg" in state
                                else torch.zeros_like(v)).detach().clone()
        return dict(losses=list(self.losses), first_grad=first, start=start,
                    after={k: v.detach().clone()
                           for k, v in self.values.items()})

    def release(self) -> None:
        for name in ("values", "opt", "scene", "target", "occluders"):
            setattr(self, name, None)
        self.draws = None


class ShardedFitJob(FitJob):
    """``FitJob``'s variant-B step with the forward of
    ``parallel.train.make_train_step_fused``:
    ``parallel.fast.render_path_fused_sharded`` over
    ``parallel.mesh.make_ray_mesh()``. Each rank of the process group
    renders its rows of pixels on its card (the records_only and draws
    choice made for its own pixel count), the image is gathered on every
    rank, every rank takes the loss from it, and ``mesh.replicate``'s
    backward sums the parameters' gradients across the ranks. Every rank
    draws the same start and target from the seed and steps the same Adam
    on the same sum, so the parameters stay equal on all of them.
    ``make_train_step``'s ``SceneParams`` carry no triangle albedos, so the
    scene is built as ``FitJob._scene`` builds it."""

    def __init__(self, tree, traffic, seed, device, spans,
                 fault: Optional[str] = None):
        super().__init__(tree, traffic, seed, device, spans, fault)
        self.mesh = make_ray_mesh(device)

    def _forward(self) -> torch.Tensor:
        img = render_path_fused_sharded(self._scene(), self.cfg, self.mesh,
                                        occluders=self.occluders)
        return self._loss(img, self.target)


JOBS = {"frame": FrameJob, "fit": FitJob, "sharded_fit": ShardedFitJob}
