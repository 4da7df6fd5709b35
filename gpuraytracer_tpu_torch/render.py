"""Eager PyTorch renderer of the variant-B path tracer — the oracle.

Counterpart of ``gpuraytracer_tpu/render.py`` for the ``path`` and
``direct`` integrators (``pathTrace``, RTrace/raytrace.metal:11-111): an
iterative next-event-estimation + cosine-bounce path tracer. Per-thread
``break``s become masked arithmetic: every lane computes every bounce and
masks decide what accumulates. Pixels are processed in chunks of
``config.pixel_chunk`` to bound the [rays, triangles] working set.

This is the slow, readable reference the kernels are held against; the fast
path is ``ops/cuda_path.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import sampling as smp
from .intersect import RAY_TMAX, RAY_TMIN, any_hit, closest_hit, compile_scene
from .types import CompiledScene, RenderConfig, Scene
from .utils.host import resolve_device


class RenderOutput(NamedTuple):
    hdr: torch.Tensor  # [H, W, 3] f32 linear radiance (pre-tonemap)
    ldr: Optional[torch.Tensor]  # [H, W, 3] f32 in [0,1] (mis integrator only)


def pixel_coords(config: RenderConfig,
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened row-major pixel coordinates [N] (x fastest, like the
    reference's thread grid)."""
    idx = torch.arange(config.num_pixels, dtype=torch.int64, device=device)
    return idx % config.width, idx // config.width


def pixel_rng_offsets(config: RenderConfig, device="cpu") -> torch.Tensor:
    """Per-pixel Halton index offsets, [N] int64 in [0, 2^20).

    The reference seeds a texture host-side with ``arc4random() %
    (1024*1024)`` (RTrace/renderer.swift:96-110). The same range is kept but
    derived deterministically from (pixel index, config.seed), in uint32
    arithmetic carried as int64, bit-identical to the JAX package."""
    idx = torch.arange(config.num_pixels, dtype=torch.int64, device=device)
    seed_term = (config.seed * 0x9E3779B9) & 0xFFFFFFFF
    seeded = smp.hash_u32((idx * 9781 + seed_term) & 0xFFFFFFFF)
    return seeded % (1024 * 1024)


def _path_trace_chunk(
    compiled: CompiledScene, scene: Scene, config: RenderConfig,
    px: torch.Tensor, py: torch.Tensor, offsets: torch.Tensor,
) -> torch.Tensor:
    """One chunk of pixels, all spp, fixed bounce loop. Returns [chunk, 3]."""
    cam = scene.camera
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    lum = torch.zeros(px.shape + (3,), dtype=torch.float32, device=px.device)

    for n in range(config.spp):
        # Per-sample jitter: Halton dims 0,1 at index offset+n
        # (raytrace.metal:37-40); stratified jitter grids the same draws
        # over spp cells.
        i_halton = offsets + n
        if config.sampler == "stratified":
            uv = smp.stratified2(i_halton, 0, config.spp)
        else:
            uv = torch.stack([smp.halton(i_halton, 0),
                              smp.halton(i_halton, 1)], dim=-1)
        o, d = smp.generate_camera_ray(
            cam.position, cam.direction, cam.up, config.resolution,
            cam.horizontal_fov, px, py, uv, config.integer_aspect,
        )

        color = torch.ones_like(d)
        acc = torch.zeros_like(d)
        alive = torch.ones(px.shape, dtype=torch.bool, device=px.device)

        for bounce in range(config.bounces):
            h = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, spheres)
            active = alive & h.hit
            # Emissive hit REPLACES the accumulator and terminates — the
            # reference's `accumulatedColor = emissive; break`
            # (raytrace.metal:57-60), discarding prior NEE sums.
            hit_light = active & h.is_emissive
            acc = torch.where(hit_light[..., None], h.emissive, acc)
            surf = active & ~h.is_emissive

            normal = h.normal
            # t clamped to 0 on dead lanes: their shading math still
            # executes (fixed-shape masking) and must stay finite.
            t_safe = torch.where(surf, h.t, torch.zeros_like(h.t))
            point = o + d * t_safe[..., None] + normal * 1e-3

            # NEE: Halton dims 2 + bounce*5 + {0,1} (raytrace.metal:72-74).
            w = torch.stack(
                [smp.halton(i_halton, 2 + bounce * 5 + 0),
                 smp.halton(i_halton, 2 + bounce * 5 + 1)], dim=-1)
            lcol, ldir, ldist = smp.sample_area_light(
                light.center, light.color, light.normal, point, w,
                config.area_light_half_extent,
            )
            lcol = lcol * smp.saturate(smp.dot(normal, ldir))[..., None]
            color = torch.where(surf[..., None], color * h.diffuse, color)

            # Shadow ray: any-hit, max = lightDist - 1e-3, min unset (0)
            # (raytrace.metal:79-85).
            occluded = any_hit(compiled, point, ldir, 0.0, ldist - 1e-3,
                               spheres)
            contrib = torch.where((surf & ~occluded)[..., None], lcol * color,
                                  torch.zeros_like(color))
            acc = acc + contrib

            # Indirect bounce: cosine hemisphere, Halton dims {2,3} of the
            # same block (raytrace.metal:93-100).
            u = torch.stack(
                [smp.halton(i_halton, 2 + bounce * 5 + 2),
                 smp.halton(i_halton, 2 + bounce * 5 + 3)], dim=-1)
            sdir = smp.align_hemisphere_with_normal(
                smp.cosine_hemisphere_y_up(u), normal)
            o = torch.where(surf[..., None], point, o)
            d = torch.where(surf[..., None], sdir, d)
            alive = surf

        lum = lum + acc

    return lum / float(config.spp)


def render_path(scene: Scene, config: RenderConfig,
                device="cuda") -> RenderOutput:
    """Variant-B path trace in eager PyTorch on ``device``."""
    device = resolve_device(device)
    scene = scene.to(device)
    compiled = compile_scene(scene.triangles)
    px, py = pixel_coords(config, device)
    offsets = pixel_rng_offsets(config, device)
    chunk = min(config.pixel_chunk, config.num_pixels)
    parts = [
        _path_trace_chunk(compiled, scene, config, px[s:s + chunk],
                          py[s:s + chunk], offsets[s:s + chunk])
        for s in range(0, config.num_pixels, chunk)
    ]
    hdr = torch.cat(parts, dim=0)
    return RenderOutput(hdr=hdr.reshape(config.height, config.width, 3),
                        ldr=None)


def render(scene: Scene, config: RenderConfig, device="cuda") -> RenderOutput:
    """Render with the configured integrator."""
    if config.integrator == "path":
        return render_path(scene, config, device)
    if config.integrator == "direct":
        return render_path(scene, config.replace(bounces=1), device)
    if config.integrator == "mis":
        raise NotImplementedError(
            "integrator 'mis' (variant-A MIS): a later slice of the port")
    if config.integrator == "legacy":
        raise NotImplementedError(
            "integrator 'legacy' (legacy nested-MIS tier): a later slice of"
            " the port")
    raise ValueError(f"unknown integrator: {config.integrator!r}")
