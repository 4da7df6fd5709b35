"""Edge-aware differentiable direct-lighting renderer: the eager oracle of
the silhouette path.

Counterpart of ``gpuraytracer_tpu/grad/diff_render.py``. Autograd through a
path tracer gives *interior* gradients only: which primitive a ray hits is a
step function, so moving a sphere never changes the pixels it covers as far
as autograd can see, and recovering a sphere's position from an image fails.
This renderer adds the missing *silhouette* term for sphere geometry with a
forward-exact / backward-soft coverage:

  alpha_hard = [the sphere is the closest hit]             (exact, forward)
  h          = distance of the ray from the sphere's center
  alpha_soft = sigmoid((r - h) / (kappa * r))              (smooth in c, r)
  alpha      = alpha_hard + alpha_soft - alpha_soft.detach()

``alpha`` evaluates to the hard visibility but differentiates like the
smooth coverage. A pixel is the composite alpha * L_sphere + (1 - alpha) *
L_background, with L_background the triangle-only shading of the same ray.
Primary visibility of spheres under direct lighting only: shadow rays and
triangle silhouettes stay hard.

Quirks of the reference estimator, kept as they are (``ROADMAP.md`` queue 3):
on a lane whose sphere is not in front, L_sphere is still evaluated, with the
normal taken at t = 1 and the shading point at the camera; and a ray that
misses every sphere measures its coverage against sphere 0, the default of
the argmin.

The fast path is ``ops/cuda_soft.render_direct_soft_fused`` (trace kernel,
silhouette record kernel, hand-written backward kernel), with this
function's gradients.
"""
from __future__ import annotations

import torch

from .. import sampling as smp
from ..intersect import (RAY_TMAX, RAY_TMIN, _sphere_candidates, any_hit,
                         closest_hit, compile_scene)
from ..render import pixel_coords, pixel_rng_offsets
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device

_F32 = torch.float32


def _shade_direct(compiled, scene: Scene, config: RenderConfig, o, d, t,
                  normal, diffuse, active, i_halton, spheres):
    """Variant-B next-event estimation at a hit point (raytrace.metal:66-89):
    sample the area light, cosine term, diffuse throughput, hard shadow
    ray."""
    light = scene.light
    t_safe = torch.where(active, t, torch.zeros_like(t))
    point = o + d * t_safe[..., None] + normal * 1e-3
    w = torch.stack([smp.halton(i_halton, 2), smp.halton(i_halton, 3)],
                    dim=-1)
    lcol, ldir, ldist = smp.sample_area_light(
        light.center, light.color, light.normal, point, w,
        config.area_light_half_extent)
    lcol = lcol * smp.saturate(smp.dot(normal, ldir))[..., None]
    occluded = any_hit(compiled, point, ldir, 0.0, ldist - 1e-3, spheres)
    return lcol * diffuse * (~occluded).to(_F32)[..., None]


def _one_sample(compiled, scene: Scene, config: RenderConfig, kappa: float,
                px, py, offsets, n: int) -> torch.Tensor:
    """One sample of every pixel given, [n, 3]."""
    cam = scene.camera
    spheres = scene.spheres
    i_halton = offsets + n
    uv = torch.stack([smp.halton(i_halton, 0), smp.halton(i_halton, 1)],
                     dim=-1)
    o, d = smp.generate_camera_ray(
        cam.position, cam.direction, cam.up, config.resolution,
        cam.horizontal_fov, px, py, uv, config.integer_aspect)

    # Triangle-only closest hit: the background layer.
    ht = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, None)
    # Sphere candidates: the closest sphere (sphere 0 when none is hit).
    t_s_all, valid_s = _sphere_candidates(spheres, o, d, RAY_TMIN, RAY_TMAX)
    t_s_masked = torch.where(valid_s, t_s_all, torch.full_like(t_s_all, 1e30))
    s_idx = torch.argmin(t_s_masked, dim=-1)
    s_hit = torch.gather(valid_s, -1, s_idx[..., None])[..., 0]
    t_s = torch.gather(t_s_all, -1, s_idx[..., None])[..., 0]
    center = spheres.center[s_idx]
    radius = spheres.radius[s_idx]
    s_diffuse = spheres.diffuse[s_idx]
    s_emissive = spheres.emissive[s_idx]

    sphere_front = s_hit & (t_s < ht.t)

    # Distance of the ray from the center -> smooth coverage, its gradient
    # gated to spheres whose closest approach lies in front of the
    # background (an occluded sphere has no silhouette to move).
    oc = center - o
    t_ca = smp.dot(oc, d)  # d is normalized
    h2 = torch.clamp_min(smp.dot(oc, oc) - t_ca * t_ca, 1e-12)
    h = torch.sqrt(h2)
    potential = (t_ca > RAY_TMIN) & (t_ca < ht.t)
    alpha_soft = torch.sigmoid((radius - h) / (kappa * radius))
    alpha_soft = torch.where(potential, alpha_soft,
                             torch.zeros_like(alpha_soft))
    alpha = sphere_front.to(_F32) + alpha_soft - alpha_soft.detach()

    # Sphere layer, finite on every lane.
    t_s_safe = torch.where(sphere_front, t_s, torch.ones_like(t_s))
    p_s = o + d * t_s_safe[..., None]
    to_c = p_s - center
    n_s = to_c * smp.rsqrt(
        torch.clamp_min(smp.dot(to_c, to_c), 1e-6))[..., None]
    l_s = _shade_direct(compiled, scene, config, o, d, t_s_safe, n_s,
                        s_diffuse, sphere_front, i_halton, spheres)
    l_s = l_s + s_emissive

    # Background (triangle) layer: an emissive hit shows its emission, a
    # surface hit gets next-event estimation, a miss is black.
    tri_surf = ht.hit & ~ht.is_emissive
    l_t = _shade_direct(compiled, scene, config, o, d, ht.t, ht.normal,
                        ht.diffuse, tri_surf, i_halton, spheres)
    l_t = torch.where(tri_surf[..., None], l_t, torch.zeros_like(l_t))
    l_t = torch.where((ht.hit & ht.is_emissive)[..., None], ht.emissive, l_t)

    return alpha[..., None] * l_s + (1.0 - alpha[..., None]) * l_t


def render_direct_soft(scene: Scene, config: RenderConfig,
                       kappa: float = 0.05, device="cuda") -> torch.Tensor:
    """Direct-lighting render on ``device`` whose value equals the hard
    render (``integrator="direct"``) but whose gradients include the
    sphere-silhouette terms. Returns [H, W, 3] linear radiance. Like the
    JAX oracle it takes the camera jitter from Halton dimensions 0-1
    whatever ``config.sampler`` says. Pixels go through in chunks of
    ``config.pixel_chunk``."""
    device = resolve_device(device)
    scene = scene.to(device)
    assert scene.spheres.num_spheres > 0, \
        "soft renderer requires sphere geometry"
    compiled = compile_scene(scene.triangles)
    px, py = pixel_coords(config, device)
    offsets = pixel_rng_offsets(config, device)
    chunk = min(config.pixel_chunk, config.num_pixels)
    parts = []
    for s in range(0, config.num_pixels, chunk):
        sl = slice(s, s + chunk)
        lum = torch.zeros((px[sl].shape[0], 3), dtype=_F32, device=device)
        for n in range(config.spp):
            lum = lum + _one_sample(compiled, scene, config, kappa, px[sl],
                                    py[sl], offsets[sl], n)
        parts.append(lum)
    lum = torch.cat(parts, dim=0)
    return (lum / float(config.spp)).reshape(config.height, config.width, 3)
