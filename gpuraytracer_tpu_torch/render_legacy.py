"""Legacy-tier integrator — the richest feature set of the reference.

Counterpart of ``gpuraytracer_tpu/render_legacy.py``, after
``calculateLighting`` / ``recursiveLightingCalculation`` in the reference's
legacy kernel (shaders_old.metal:738-1250): a 3-strategy MIS integrator
(light / cosine / VNDF) under the beta = 2 power heuristic, whose cosine and
VNDF strategies *recurse* into the same lighting calculation at the bounce
hit with a fixed nested sample count (the reference hardcodes 30,
shaders_old.metal:837,911).

What sets this tier apart from the variant-A MIS integrator
(``render.render_mis``):

  * sphere geometry and **sphere lights** are hit-tested analytically
    (intersectSphere :108-136, intersectLight :138-170);
  * **box lights** are a next-event target through area-weighted 6-face
    sampling (sampleBoxLight :292-404) and a slab-test directional pdf
    (calculateBoxLightPdf :625-676);
  * the power heuristic takes beta = 2 (:748), not variant A's 1;
  * true recursion, ``legacy_bounces`` deep, instead of variant A's one
    extra light sample.

The reference's per-thread recursion becomes a Python recursion of fixed
depth over dense pixel batches; its ``continue`` and sentinel branches
become masks (``torch.where``, so that a NaN or an Inf on a dead lane stays
out of the image and of the gradients). Sphere lights are hit-tested as
emissive spheres appended to the sphere arrays; box lights as the 12
emissive triangles their scene holds (the ``BoxLights`` arrays drive the
sampling and the pdf only). Randomness is a pure function of (pixel,
sample, strategy, depth). Where autograd records the scene, each sample of
the per-sample loop runs under ``torch.utils.checkpoint``, so that the
backward pass holds one sample's graph at a time, as the JAX package's
``lax.scan(jax.checkpoint(...))`` does.

Plain PyTorch on any device: the JAX package has no kernel for this tier
either (its integrator is jnp).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import sampling as smp
from .brdf import brdf_contribution
from .intersect import RAY_TMAX, RAY_TMIN, closest_hit, compile_scene
from .render import RenderOutput, pixel_coords
from .types import RenderConfig, Scene, Spheres
from .utils.host import resolve_device

_MASK32 = 0xFFFFFFFF


def _combined_spheres(scene: Scene) -> Optional[Spheres]:
    """Sphere geometry + sphere lights as emissive spheres — the analog of
    the legacy ``getClosestIntersection`` looping spheres then lights
    (shaders_old.metal:172-200). Spheres are numbered after the triangles,
    the lights after the spheres."""
    sp = scene.spheres
    sl = scene.sphere_lights
    if sl.num_lights == 0:
        return sp if sp.num_spheres > 0 else None
    lights_as_spheres = Spheres(
        center=sl.center, radius=sl.radius, diffuse=sl.color,
        metallic=torch.zeros_like(sl.radius),
        roughness=torch.ones_like(sl.radius),
        emissive=sl.emitted_radiance)
    if sp.num_spheres == 0:
        return lights_as_spheres
    return Spheres(**{
        f.name: torch.cat([getattr(sp, f.name),
                           getattr(lights_as_spheres, f.name)], dim=0)
        for f in dataclasses.fields(Spheres)})


def _light_kind(scene: Scene) -> str:
    """The next-event target, chosen on the host: the reference handles
    'only one light atm' (shaders_old.metal:743); the legacy light types
    come first where the scene has them."""
    if scene.sphere_lights.num_lights > 0:
        return "sphere"
    if scene.box_lights.num_lights > 0:
        return "box"
    return "square"


def _rng2(px, py, sample_i: int, strategy: int, depth: int, draw: int):
    """[..., 2] uniforms, a pure function of (pixel, sample, strategy, depth,
    draw): ``hash_random_2d`` at (1 + draw) + sample 9 + strategy 2^16 +
    depth 2^20 in uint32 arithmetic (the replacement of the legacy
    hashRandom stream, shaders_old.metal:749, keyed on indices so that a
    render does not depend on its resolution)."""
    c = ((1 + draw) + sample_i * 9 + strategy * (1 << 16)
         + depth * (1 << 20)) & _MASK32
    return smp.hash_random_2d(px, py, c)


def _sample_light(scene: Scene, kind: str, point, u2, u3):
    """A next-event direction and its pdf from the scene's primary light."""
    if kind == "sphere":
        sl = scene.sphere_lights
        return smp.sample_sphere_light(sl.center[0], sl.radius[0], point, u2)
    if kind == "box":
        bl = scene.box_lights
        return smp.sample_box_light(bl.center[0], bl.width[0], bl.height[0],
                                    bl.depth[0], point, u3)
    light = scene.light
    ldir, _ = smp.direct_square_light_sample(
        point, light.center, light.width, light.depth, light.normal, u2)
    pdf = smp.square_light_pdf(point, light.center, light.width, light.depth,
                               light.normal, ldir)
    return ldir, pdf


def _light_pdf(scene: Scene, kind: str, point, direction):
    """Pdf of ``direction`` under the light strategy (the cross-strategy
    term of the MIS weights). Sphere lights take the direction-independent
    cone pdf, as the reference does (calculateLightPdf,
    shaders_old.metal:617-623)."""
    if kind == "sphere":
        sl = scene.sphere_lights
        return smp.sphere_light_pdf(sl.center[0], sl.radius[0], point)
    if kind == "box":
        bl = scene.box_lights
        return smp.box_light_pdf(bl.center[0], bl.width[0], bl.height[0],
                                 bl.depth[0], point, direction)
    light = scene.light
    return smp.square_light_pdf(point, light.center, light.width, light.depth,
                                light.normal, direction)


def _trace_radiance(compiled, spheres, origin, direction):
    """``traceTriangleLightRay`` (shaders_old.metal:20-51): the origin moved
    1e-4 along the ray, the closest hit; returns (radiance, hit-light mask,
    hit). The reference's (-1, -1, -1) sentinel becomes the mask."""
    h = closest_hit(compiled, origin + direction * 1e-4, direction,
                    RAY_TMIN, RAY_TMAX, spheres)
    return h.emissive, h.hit & h.is_emissive, h


def _masked(mask, value):
    return torch.where(mask[..., None], value, torch.zeros_like(value))


def _calculate_lighting(compiled, spheres, scene: Scene, config: RenderConfig,
                        kind: str, px, py, point, normal, in_dir, diffuse,
                        metallic, roughness, active, samples: int,
                        depth: int, record: bool):
    """One level of ``calculateLighting`` (shaders_old.metal:738-921) over a
    dense pixel batch. Returns [..., 3] radiance. ``depth`` counts the
    bounces left; at depth > 1 the cosine and VNDF strategies recurse with
    ``legacy_bounce_samples``, as the reference does with its hardcoded
    30. ``record``: autograd records the scene, so each sample runs under
    ``torch.utils.checkpoint``."""
    spb = max(samples // 3, 1)
    beta = 2.0  # shaders_old.metal:748
    mat = (diffuse, metallic, roughness)

    def strategy_light(i):
        u2 = _rng2(px, py, i, 0, depth, 0)
        u3 = torch.cat([u2, _rng2(px, py, i, 0, depth, 1)[..., :1]], dim=-1)
        ldir, pdf_l = _sample_light(scene, kind, point, u2, u3)
        pdf_c = smp.cosine_pdf(normal, ldir)
        pdf_v = smp.vndf_pdf(-in_dir, normal, ldir, roughness)
        radiance, hit_light, _ = _trace_radiance(compiled, spheres, point,
                                                 ldir)
        w = smp.power_heuristic_3(pdf_l, pdf_c, pdf_v, spb, beta)
        brdf = brdf_contribution(in_dir, normal, *mat, ldir)
        term = brdf * radiance * (w / torch.clamp_min(pdf_l, 1e-8))[..., None]
        return _masked(active & hit_light, term)

    def strategy_bsdf(i, strategy: int):
        """The cosine (strategy 1) and VNDF (strategy 2) body, with the
        nested bounce recursion (shaders_old.metal:769-841, 843-921)."""
        u2 = _rng2(px, py, i, strategy, depth, 0)
        if strategy == 1:
            sdir = smp.cosine_weighted_dir(normal, u2)
            pdf_self = smp.cosine_pdf(normal, sdir)
            pdf_o1 = _light_pdf(scene, kind, point, sdir)
            pdf_o2 = smp.vndf_pdf(-in_dir, normal, sdir, roughness)
        else:
            sdir = smp.vndf_dir(-in_dir, normal, roughness, u2)
            pdf_self = smp.vndf_pdf(-in_dir, normal, sdir, roughness)
            pdf_o1 = _light_pdf(scene, kind, point, sdir)
            pdf_o2 = smp.cosine_pdf(normal, sdir)

        radiance, hit_light, h = _trace_radiance(compiled, spheres, point,
                                                 sdir)
        w = smp.power_heuristic_3(pdf_self, pdf_o1, pdf_o2, spb, beta)
        brdf = brdf_contribution(in_dir, normal, *mat, sdir)
        direct = brdf * radiance * (
            w / torch.clamp_min(pdf_self, 1e-8))[..., None]
        direct = _masked(active & hit_light, direct)

        if depth <= 1:
            return direct, torch.zeros_like(direct)

        # Nested recursion: a non-emissive hit evaluates the lighting at the
        # bounce point with legacy_bounce_samples, weighted by brdf / pdf
        # (shaders_old.metal:824-839, 898-913). The reference evaluates that
        # BRDF with the *bounce hit's* material in the incoming surface's
        # frame; so does this.
        hit_geo = active & h.hit & ~h.is_emissive
        t_safe = torch.where(hit_geo, h.t, torch.zeros_like(h.t))
        bpoint = (point + sdir * 1e-4) + sdir * t_safe[..., None]
        bpoint = bpoint + h.normal * 1e-4
        nested = _calculate_lighting(
            compiled, spheres, scene, config, kind, px, py,
            bpoint, h.normal, sdir, h.diffuse, h.metallic, h.roughness,
            hit_geo, config.legacy_bounce_samples, depth - 1, record)
        brdf_b = brdf_contribution(in_dir, normal, h.diffuse, h.metallic,
                                   h.roughness, sdir)
        throughput = brdf_b / (pdf_self[..., None] + 1e-6)
        return direct, _masked(hit_geo, throughput * nested)

    def one_sample(total, bounce, i):
        d0 = strategy_light(i)
        d1, b1 = strategy_bsdf(i, 1)
        d2, b2 = strategy_bsdf(i, 2)
        return total + d0 + d1 + d2, bounce + b1 + b2

    total = torch.zeros(px.shape + (3,), dtype=torch.float32,
                        device=px.device)
    bounce = torch.zeros_like(total)
    for i in range(spb):
        if record:
            total, bounce = checkpoint(one_sample, total, bounce, i,
                                       use_reentrant=False)
        else:
            total, bounce = one_sample(total, bounce, i)
    # totalLight / (3 spb) + bounceLight / (2 spb): the reference's literal
    # /60 at spb = 30 (shaders_old.metal:917).
    return (total / torch.tensor(3.0 * spb, device=total.device)
            + bounce / torch.tensor(2.0 * spb, device=total.device))


def _legacy_chunk(compiled, spheres, scene: Scene, config: RenderConfig,
                  kind: str, record: bool, px, py):
    """One pixel chunk through the legacy pipeline: a camera ray through the
    pixel's center (the legacy kernel has no jitter, shaders_old.metal:
    1261-1286), its closest hit, then miss -> 0, light -> its radiance,
    surface -> ``_calculate_lighting``."""
    cam = scene.camera
    uv = torch.full(px.shape + (2,), 0.5, dtype=torch.float32,
                    device=px.device)
    o, d = smp.generate_camera_ray(
        cam.position, cam.direction, cam.up, config.resolution,
        cam.horizontal_fov, px, py, uv, config.integer_aspect)
    h = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, spheres)

    hit_light = h.hit & h.is_emissive
    surf = h.hit & ~h.is_emissive
    t_safe = torch.where(surf, h.t, torch.zeros_like(h.t))
    point = o + d * t_safe[..., None] + h.normal * 1e-4

    lit = _calculate_lighting(
        compiled, spheres, scene, config, kind, px, py, point, h.normal, d,
        h.diffuse, h.metallic, h.roughness, surf,
        config.legacy_samples, config.legacy_bounces, record)
    return _masked(hit_light, h.emissive) + _masked(surf, lit)


def render_legacy(scene: Scene, config: RenderConfig,
                  device="cuda") -> RenderOutput:
    """The legacy integrator (drawTriangle, shaders_old.metal:1255-1409) on
    ``device``: one camera ray a pixel, ``legacy_bounces`` deep, the sphere,
    box or square light as the next-event target, chosen from the scene's
    light arrays. Differentiable by autograd. Returns ``RenderOutput(hdr,
    ldr=None)``; the pixels go through in chunks of ``config.pixel_chunk``.

    The triangles are not padded (the JAX package pads them to
    ``config.lane_pad``), so a sphere's primitive number here is the
    triangle count plus its index; nothing in this tier reads it."""
    device = resolve_device(device)
    scene = scene.to(device)
    compiled = compile_scene(scene.triangles)
    spheres = _combined_spheres(scene)
    kind = _light_kind(scene)
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in scene.tensors())
    px, py = pixel_coords(config, device)
    chunk = min(config.pixel_chunk, config.num_pixels)
    hdr = torch.cat([
        _legacy_chunk(compiled, spheres, scene, config, kind, record,
                      px[s:s + chunk], py[s:s + chunk])
        for s in range(0, config.num_pixels, chunk)], dim=0)
    return RenderOutput(hdr=hdr.reshape(config.height, config.width, 3),
                        ldr=None)
