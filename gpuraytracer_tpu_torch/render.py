"""Eager PyTorch renderers — the oracles.

Counterpart of ``gpuraytracer_tpu/render.py``:

  * ``path`` / ``direct`` (``pathTrace``, RTrace/raytrace.metal:11-111): an
    iterative next-event-estimation + cosine-bounce path tracer;
  * ``mis`` (``drawTriangle`` + ``recursiveMultiImportanceSampling``,
    Sources/gpuRaytracer/shaders.metal:519-707): per pixel ``camera_rays``
    hash-jittered primary rays, each shaded with ``mis_samples // 3`` samples
    of three strategies (light / cosine / VNDF-GGX) under the beta = 1 power
    heuristic, with one unweighted light sample at the first bounce hit of
    the two BSDF strategies.

Per-thread ``break``s become masked arithmetic: every lane computes every
step and masks decide what accumulates. Pixels are processed in chunks of
``config.pixel_chunk`` to bound the [rays, triangles] working set. Both
renderers are differentiable by ``torch.autograd`` on a scene whose tensors
ask for gradients.

These are the slow, readable references the kernels are held against; the
fast paths are ``ops/cuda_path.py`` and ``ops/cuda_mis.py``. ``render``
also dispatches ``integrator="legacy"`` to ``render_legacy.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import sampling as smp
from .brdf import brdf_contribution
from .intersect import RAY_TMAX, RAY_TMIN, any_hit, closest_hit, compile_scene
from .types import CompiledScene, RenderConfig, Scene
from .utils.host import resolve_device
from .utils.metrics import traced


class RenderOutput(NamedTuple):
    hdr: torch.Tensor  # [H, W, 3] f32 linear radiance (pre-tonemap)
    ldr: Optional[torch.Tensor]  # [H, W, 3] f32 in [0,1] (mis integrator only)


def pixel_coords(config: RenderConfig,
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened row-major pixel coordinates [N] (x fastest, like the
    reference's thread grid)."""
    idx = torch.arange(config.num_pixels, dtype=torch.int64, device=device)
    return idx % config.width, idx // config.width


@traced("pack")
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


# ---------------------------------------------------------------------------
# Variant A: 3-strategy MIS (shaders.metal:519-707)
# ---------------------------------------------------------------------------

def _mis_sample_tables(config: RenderConfig, device="cpu"):
    """The reference's per-sample randoms are pixel-independent Halton points
    (haltonRandom(i, d), shaders.metal:557,564,584,595,617), so they are
    shared tables, [S, 2] each, built from the row table the kernel also
    reads (``sampling.mis_sample_table_rows``)."""
    rows = smp.mis_sample_table_rows(config.mis_samples,
                                     config.sampler).to(device)

    def pair(r):
        return torch.stack([rows[r], rows[r + 1]], dim=-1)

    return dict(
        light_u=pair(0),       # strategy 1
        cosine_u=pair(2),      # strategy 2
        cosine_sec_u=pair(4),  # strategy 2 bounce NEE
        vndf_u=pair(6),        # strategy 3
        vndf_sec_u=pair(8),    # strategy 3 bounce NEE
    )


def _direct_light_contribution(
    compiled: CompiledScene, scene: Scene,
    point, normal, in_dir, diffuse, metallic, roughness,
    u: torch.Tensor, samples_per_strategy: int, use_power_heuristic: bool,
    active: torch.Tensor,
):
    """``calculateDirectLightSamplingContribution`` (shaders.metal:519-541):
    sample the full light rectangle, trace toward it, and contribute iff the
    light is reached. Returns [..., 3].

    The reference classifies by closest-hit-is-emissive. This is the
    equivalent *occlusion* form — any hit strictly short of the sample
    distance blocks the contribution — because the reference's first Halton
    sample (halton(0, d) == 0) lands exactly on the light rectangle's corner,
    where the closest-hit classification flips with the last bit. The two
    forms agree everywhere but on that measure-zero edge set."""
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    origin = point + normal * 1e-4
    ldir, ldist = smp.direct_square_light_sample(
        origin, light.center, light.width, light.depth, light.normal, u)
    pdf_l = smp.square_light_pdf(
        point, light.center, light.width, light.depth, light.normal, ldir)
    # The occluder window stops short of the light plane, so that the light
    # itself (hit at t ~= ldist) never registers as a blocker.
    occluded = any_hit(compiled, origin, ldir, RAY_TMIN, ldist * (1.0 - 1e-4),
                       spheres)
    hit_light = active & ~occluded
    brdf = brdf_contribution(in_dir, normal, diffuse, metallic, roughness,
                             ldir)
    contrib = brdf * light.emitted_radiance / pdf_l[..., None]
    if use_power_heuristic:
        pdf_c = smp.cosine_pdf(normal, ldir)
        pdf_v = smp.vndf_pdf(-in_dir, normal, ldir, roughness)
        weight = smp.power_heuristic_3(pdf_l, pdf_c, pdf_v,
                                       samples_per_strategy, 1.0)
        contrib = contrib * weight[..., None]
    return torch.where(hit_light[..., None], contrib,
                       torch.zeros_like(contrib))


def _bounce_strategy(
    compiled: CompiledScene, scene: Scene,
    point, normal, in_dir, diffuse, metallic, roughness, active,
    sample_dir: torch.Tensor, pdf_self: torch.Tensor, weight: torch.Tensor,
    sec_u: torch.Tensor,
):
    """Shared body of the cosine/VNDF strategies (shaders.metal:562-623):
    trace the BSDF-sampled ray; if it hits the light, add the MIS-weighted
    light term; if it hits geometry, do one unweighted light sample at the
    bounce point (the reference's single-level 'recursion')."""
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    origin = point + normal * 1e-4
    h = closest_hit(compiled, origin, sample_dir, RAY_TMIN, RAY_TMAX, spheres)
    brdf = brdf_contribution(in_dir, normal, diffuse, metallic, roughness,
                             sample_dir)
    # Double-where reciprocal: the VNDF pdf is EXACTLY 0 on roughness-0
    # lanes (d_ggx's numerator is a^2), and 1/0 = inf there turns the
    # MIS-weighted product into 0 * inf = NaN — gated out of the image but
    # poisoning every gradient that flows through the product. pdf == 0
    # always implies weight == 0, so inv_pdf := 0 realizes the estimator's
    # 0 * (x / 0) := 0.
    pdf_ok = pdf_self > 0.0
    inv_pdf = torch.where(
        pdf_ok, 1.0 / torch.where(pdf_ok, pdf_self, torch.ones_like(pdf_self)),
        torch.zeros_like(pdf_self))[..., None]

    hit_light = active & h.hit & h.is_emissive
    light_term = weight[..., None] * brdf * light.emitted_radiance * inv_pdf

    hit_geo = active & h.hit & ~h.is_emissive
    bounce_point = origin + sample_dir * torch.where(
        hit_geo, h.t, torch.zeros_like(h.t))[..., None]
    sec = _direct_light_contribution(
        compiled, scene, bounce_point, h.normal, sample_dir,
        h.diffuse, h.metallic, h.roughness, sec_u, 1, False, hit_geo,
    )
    geo_term = brdf * inv_pdf * sec
    zero = torch.zeros_like(geo_term)
    return (torch.where(hit_light[..., None], light_term, zero)
            + torch.where(hit_geo[..., None], geo_term, zero))


def _mis_chunk(
    compiled: CompiledScene, scene: Scene, config: RenderConfig,
    tables: dict, px: torch.Tensor, py: torch.Tensor,
) -> torch.Tensor:
    """One chunk of pixels through the full variant-A pipeline. Returns
    [chunk, 3] of raw accumulated color (pre exposure/tonemap) — the
    reference's debug/text-buffer value (shaders.metal:705). Sum order:
    samples ascending, then / s_per, then camera rays ascending."""
    cam = scene.camera
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    s_per = config.mis_samples // 3

    accumulated = torch.zeros(px.shape + (3,), dtype=torch.float32,
                              device=px.device)
    for i in range(config.camera_rays):
        jitter = smp.hash_random_2d(px, py, i)
        o, d = smp.generate_camera_ray(
            cam.position, cam.direction, cam.up, config.resolution,
            cam.horizontal_fov, px, py, jitter, config.integer_aspect,
        )
        h = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, spheres)
        # Camera ray hit the light directly: add emittedRadiance
        # (shaders.metal:667-671).
        cam_hit_light = h.hit & h.is_emissive
        accumulated = accumulated + torch.where(
            cam_hit_light[..., None], light.emitted_radiance,
            torch.zeros_like(accumulated))

        surf = h.hit & ~h.is_emissive
        # NOT normal-offset (shaders.metal:497); t clamped on dead lanes.
        point = o + d * torch.where(surf, h.t, torch.zeros_like(h.t))[..., None]
        args = (point, h.normal, d, h.diffuse, h.metallic, h.roughness)
        normal, roughness = h.normal, h.roughness

        mis_sum = torch.zeros_like(accumulated)
        for s in range(s_per):
            lu, cu, csu, vu, vsu = (
                tables[k][s].expand(px.shape + (2,))
                for k in ("light_u", "cosine_u", "cosine_sec_u", "vndf_u",
                          "vndf_sec_u"))
            # Strategy 1: light sampling (shaders.metal:553-560).
            direct = _direct_light_contribution(
                compiled, scene, *args, lu, s_per, True, surf)
            # Strategy 2: cosine (shaders.metal:562-591).
            cdir = smp.cosine_weighted_dir(normal, cu)
            pdf_c = smp.cosine_pdf(normal, cdir)
            pdf_l = smp.square_light_pdf(
                point, light.center, light.width, light.depth,
                light.normal, cdir)
            pdf_v = smp.vndf_pdf(-d, normal, cdir, roughness)
            w_c = smp.power_heuristic_3(pdf_c, pdf_l, pdf_v, s_per, 1.0)
            cosine = _bounce_strategy(
                compiled, scene, *args, surf, cdir, pdf_c, w_c, csu)
            # Strategy 3: VNDF (shaders.metal:593-623).
            vdir = smp.vndf_dir(-d, normal, roughness, vu)
            pdf_v2 = smp.vndf_pdf(-d, normal, vdir, roughness)
            pdf_l2 = smp.square_light_pdf(
                point, light.center, light.width, light.depth,
                light.normal, vdir)
            pdf_c2 = smp.cosine_pdf(normal, vdir)
            w_v = smp.power_heuristic_3(pdf_v2, pdf_l2, pdf_c2, s_per, 1.0)
            vndf = _bounce_strategy(
                compiled, scene, *args, surf, vdir, pdf_v2, w_v, vsu)
            mis_sum = mis_sum + direct + cosine + vndf

        sampled = mis_sum / float(s_per)
        accumulated = accumulated + torch.where(
            surf[..., None], sampled, torch.zeros_like(sampled))

    return accumulated


def camera_exposure(ev100: torch.Tensor) -> torch.Tensor:
    """1 / (1.2 * 2^ev100) (shaders.metal:145-150)."""
    return 1.0 / (1.2 * torch.pow(2.0, ev100))


def reinhard(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + clamp, no gamma (shaders.metal:152-157)."""
    return torch.clamp(color / (color + 1.0), 0.0, 1.0)


def tonemap_mis(accumulated: torch.Tensor, camera_rays: int,
                ev100: torch.Tensor) -> torch.Tensor:
    """Variant-A in-kernel post: mean over camera rays, exposure, Reinhard,
    gamma 2.2 (shaders.metal:688-703)."""
    exposed = (accumulated / float(camera_rays)
               * camera_exposure(ev100.to(accumulated.device)))
    return torch.pow(reinhard(exposed), 1.0 / 2.2)


def render_mis(scene: Scene, config: RenderConfig,
               device="cuda") -> RenderOutput:
    """Variant-A MIS render in eager PyTorch on ``device``: raw accumulated
    hdr and the tonemapped ldr."""
    device = resolve_device(device)
    scene = scene.to(device)
    if config.mis_samples < 3 or config.camera_rays < 1:
        raise ValueError("mis_samples must be at least 3 and camera_rays at "
                         "least 1")
    compiled = compile_scene(scene.triangles)
    tables = _mis_sample_tables(config, device)
    px, py = pixel_coords(config, device)
    chunk = min(config.pixel_chunk, config.num_pixels)
    parts = [
        _mis_chunk(compiled, scene, config, tables, px[s:s + chunk],
                   py[s:s + chunk])
        for s in range(0, config.num_pixels, chunk)
    ]
    acc = torch.cat(parts, dim=0).reshape(config.height, config.width, 3)
    ldr = tonemap_mis(acc, config.camera_rays, scene.camera.ev100)
    return RenderOutput(hdr=acc, ldr=ldr)


def render(scene: Scene, config: RenderConfig, device="cuda") -> RenderOutput:
    """Render with the configured integrator."""
    if config.integrator == "path":
        return render_path(scene, config, device)
    if config.integrator == "direct":
        return render_path(scene, config.replace(bounces=1), device)
    if config.integrator == "mis":
        return render_mis(scene, config, device)
    if config.integrator == "legacy":
        from .render_legacy import render_legacy
        return render_legacy(scene, config, device)
    raise ValueError(f"unknown integrator: {config.integrator!r}")
